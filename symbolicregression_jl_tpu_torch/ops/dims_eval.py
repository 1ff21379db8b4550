"""Device-side dimensional-constraint check (port of ``ops/dims_eval.py``).

The Julia reference checks units by abstract interpretation with
``WildcardQuantity`` objects on the host (src/DimensionalAnalysis.jl:46-275).
As in the JAX package, a ``(value, dims[7], wildcard)`` triple runs
through the postfix slot buffer instead, one slot at a time for every
tree of the batch at once, over ONE data sample (the reference also
checks a single sample, src/DimensionalAnalysis.jl:223-257): one pass
checks a whole population on the device.

Lattice semantics (src/DimensionalAnalysis.jl:64-195):
- constants (and parameters) are *wildcards*: their dimensions are free,
  so any op can absorb them (off with ``dimensionless_constants_only``);
- `+`/`-`/`min`/`max`/`mod` require matching dims (a wildcard side adopts
  the other's dims);
- `*`/`/` add/subtract exponents; a wildcard side keeps the result wildcard;
- `^` requires a dimensionless exponent and scales the base dims by the
  exponent's *numeric value* at the sample (hence the values);
- comparisons require matching dims and return dimensionless;
- `sqrt`/`cbrt`/`square`/`cube`/`inv` scale exponents; `neg`/`abs`/... are
  dimension-preserving; every other scalar function (sin, exp, log, user
  ops, ...) requires dimensionless (or wildcard) input and returns
  dimensionless.

A violation anywhere, or a root whose dims cannot match ``y``'s, flags the
tree; the search adds ``dimensional_constraint_penalty`` (default 1000,
src/LossFunctions.jl:236-245) to that member's cost.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .encoding import LEAF_CONST, LEAF_PARAM, TreeBatch, tree_structure_arrays
from .operators import OperatorSet

__all__ = [
    "dimensional_violations_batch",
    "classify_operators",
    "violates_dimensional_constraints",
]

N_DIMS = 7
_TOL = 1e-4

# Unary classes
U_GENERIC = 0   # dimensionless in, dimensionless out
U_IDENT = 1     # dims-preserving
U_SQRT = 2
U_CBRT = 3
U_SQUARE = 4
U_CUBE = 5
U_INV = 6
U_SIGN = 7      # any dims in, dimensionless out

_UNARY_CLASS = {
    "neg": U_IDENT, "abs": U_IDENT, "relu": U_IDENT, "round": U_IDENT,
    "floor": U_IDENT, "ceil": U_IDENT,
    "sqrt": U_SQRT, "cbrt": U_CBRT, "square": U_SQUARE, "cube": U_CUBE,
    "inv": U_INV, "sign": U_SIGN,
}

# Binary classes
B_GENERIC = 0   # both dimensionless in, dimensionless out
B_ADD = 1       # matching dims, same dims out
B_MUL = 2
B_DIV = 3
B_POW = 4
B_CMP = 5       # matching dims in, dimensionless out
B_COND = 6      # (x > 0) * y : any x, y dims out

_BINARY_CLASS = {
    "+": B_ADD, "-": B_ADD, "max": B_ADD, "min": B_ADD, "mod": B_ADD,
    "*": B_MUL, "/": B_DIV, "^": B_POW,
    "greater": B_CMP, "less": B_CMP, "greater_equal": B_CMP,
    "less_equal": B_CMP, "logical_or": B_CMP, "logical_and": B_CMP,
    "atan2": B_CMP,
    "cond": B_COND,
}

# The exponent scale of each unary class (generic and sign: 0, a
# dimensionless result), as float32.
_U_SCALE = np.zeros(8, np.float32)
_U_SCALE[[U_IDENT, U_SQRT, U_CBRT, U_SQUARE, U_CUBE, U_INV]] = [1.0, 0.5, 1.0 / 3.0, 2.0, 3.0,
                                                                 -1.0]


def classify_operators(operators: OperatorSet) -> Tuple[np.ndarray, np.ndarray]:
    """Static per-op dimension-semantics class tables (unary, binary)."""
    ucls = np.asarray(
        [_UNARY_CLASS.get(op.name, U_GENERIC) for op in operators.unary] or [U_GENERIC],
        np.int32)
    bcls = np.asarray(
        [_BINARY_CLASS.get(op.name, B_GENERIC) for op in operators.binary] or [B_GENERIC],
        np.int32)
    return ucls, bcls


def _dims_match(d1, d2):
    return torch.all(torch.abs(d1 - d2) <= _TOL, dim=-1)


def _dimless(d):
    return torch.all(torch.abs(d) <= _TOL, dim=-1)


def _select(fns, o, *args):
    out = fns[0](*args).to(torch.float32)
    for j in range(1, len(fns)):
        out = torch.where(o == j, fns[j](*args).to(torch.float32), out)
    return out


@torch.no_grad()
def dimensional_violations_batch(
    batch: TreeBatch,
    x_sample: torch.Tensor,   # [F]
    x_dims: torch.Tensor,     # [F, 7]
    y_dims: torch.Tensor,     # [7]
    check_y,                  # bool
    operators: OperatorSet,
    wildcard_constants: bool = True,
    return_root: bool = False,
):
    """``violates[...batch]``: True where a tree breaks the unit constraints.
    With ``return_root`` also each root's dims [..., 7] and whether it is a
    wildcard [...]."""
    batch_shape = batch.batch_shape
    flat = batch.reshape(-1)
    T, L = flat.arity.shape
    dev = flat.arity.device
    child, _, _ = tree_structure_arrays(flat, need_depth=False)
    child = child.long()
    ucls_np, bcls_np = classify_operators(operators)
    ucls = torch.as_tensor(ucls_np, device=dev).long()
    bcls = torch.as_tensor(bcls_np, device=dev).long()
    u_scale = torch.as_tensor(_U_SCALE, device=dev)
    x_sample = x_sample.to(device=dev, dtype=torch.float32)
    x_dims = x_dims.to(device=dev, dtype=torch.float32)
    y_dims = y_dims.to(device=dev, dtype=torch.float32)
    F = x_sample.shape[0]
    # Values matter only to `^`'s exponent: without a `^` the pass skips them.
    values = bool((bcls_np == B_POW).any())
    unary = [op.fn for op in operators.unary] if values else []
    binary = [op.fn for op in operators.binary] if values else []
    rows = torch.arange(T, device=dev)
    zeros7 = torch.zeros((T, N_DIMS), dtype=torch.float32, device=dev)

    val_buf = torch.zeros((T, L), dtype=torch.float32, device=dev)
    dim_buf = torch.zeros((T, L, N_DIMS), dtype=torch.float32, device=dev)
    wild_buf = torch.zeros((T, L), dtype=torch.bool, device=dev)
    viol = torch.zeros(T, dtype=torch.bool, device=dev)
    for k in range(L):
        a = flat.arity[:, k]
        o = flat.op[:, k]
        c0, c1 = child[:, k, 0], child[:, k, 1]
        c0v, c1v = val_buf[rows, c0], val_buf[rows, c1]
        c0d, c1d = dim_buf[rows, c0], dim_buf[rows, c1]
        c0w, c1w = wild_buf[rows, c0], wild_buf[rows, c1]

        # ---- leaf ----
        is_const_leaf = (o == LEAF_CONST) | (o == LEAF_PARAM)
        fi = torch.clamp(flat.feat[:, k].long(), 0, F - 1)
        # A parameter leaf has no single value at check time (one per
        # class): NaN marks it unknown, which makes any pow on it wildcard.
        leaf_val = torch.where(o == LEAF_PARAM, torch.full_like(c0v, float("nan")),
                               torch.where(is_const_leaf, flat.const[:, k].to(torch.float32),
                                           x_sample[fi]))
        leaf_dims = torch.where(is_const_leaf[:, None], zeros7, x_dims[fi])
        leaf_wild = is_const_leaf & bool(wildcard_constants)

        # ---- unary ----
        uc = ucls[torch.clamp(o.long(), 0, ucls.shape[0] - 1)]
        u_dims = c0d * u_scale[uc][:, None]
        u_preserves = (uc != U_GENERIC) & (uc != U_SIGN)
        u_wild = c0w & u_preserves
        u_viol = (uc == U_GENERIC) & ~c0w & ~_dimless(c0d)

        # ---- binary ----
        bc = bcls[torch.clamp(o.long(), 0, bcls.shape[0] - 1)]
        both_wild = c0w & c1w
        either_wild = c0w | c1w
        add_dims = torch.where(c0w[:, None], c1d, c0d)
        add_viol = ~c0w & ~c1w & ~_dims_match(c0d, c1d)
        # Unknown exponent value (NaN, a parameter leaf): the output dims
        # are undetermined, so wildcard, never a violation.
        exp_unknown = torch.isnan(c1v)
        pow_dims = c0d * torch.where(exp_unknown, 0.0, c1v)[:, None]
        pow_viol = ~c1w & ~_dimless(c1d)
        gen_viol = (~c0w & ~_dimless(c0d)) | (~c1w & ~_dimless(c1d))
        b_dims = zeros7
        b_wild = torch.zeros_like(c0w)
        for cls_, d_, w_ in ((B_COND, c1d, c1w), (B_POW, pow_dims, c0w | exp_unknown),
                             (B_DIV, c0d - c1d, either_wild), (B_MUL, c0d + c1d, either_wild),
                             (B_ADD, add_dims, both_wild)):
            b_dims = torch.where((bc == cls_)[:, None], d_, b_dims)
            b_wild = torch.where(bc == cls_, w_, b_wild)
        b_viol = (((bc == B_ADD) | (bc == B_CMP)) & add_viol) | ((bc == B_POW) & pow_viol) \
            | ((bc == B_GENERIC) & gen_viol)

        # wildcard output dims are canonically zero (free to rescale)
        out_dims = torch.where((a == 0)[:, None], leaf_dims,
                               torch.where((a == 1)[:, None], u_dims, b_dims))
        out_wild = torch.where(a == 0, leaf_wild, torch.where(a == 1, u_wild, b_wild))
        out_dims = torch.where(out_wild[:, None], zeros7, out_dims)
        node_viol = torch.where(a == 0, False, torch.where(a == 1, u_viol, b_viol))

        # the node's value at the sample (for `^` exponents)
        val = leaf_val if values else c0v
        if unary:
            oc = torch.clamp(o, 0, len(unary) - 1)
            val = torch.where(a == 1, _select(unary, oc, c0v), val)
        if binary:
            oc = torch.clamp(o, 0, len(binary) - 1)
            val = torch.where(a == 2, _select(binary, oc, c0v, c1v), val)

        viol = viol | (node_viol & (k < flat.length))
        val_buf[:, k] = val
        dim_buf[:, k] = out_dims
        wild_buf[:, k] = out_wild
    root = torch.clamp(flat.length.long() - 1, 0, L - 1)
    root_dims = dim_buf[rows, root]
    root_wild = wild_buf[rows, root]
    y_viol = bool(check_y) & ~root_wild & ~_dims_match(root_dims, y_dims[None, :])
    viol = (viol | y_viol).reshape(batch_shape)
    if return_root:
        return viol, root_dims.reshape(*batch_shape, N_DIMS), root_wild.reshape(batch_shape)
    return viol


def violates_dimensional_constraints(tree, dataset, options=None) -> bool:
    """Host API: does this expression break the dataset's unit constraints?

    (``violates_dimensional_constraints``, src/DimensionalAnalysis.jl:223-275
    of the Julia reference.) ``tree`` is a host :class:`..ops.tree.Node`,
    ``dataset`` a :class:`..core.dataset.Dataset` with units; False when
    the dataset has no units."""
    from ..core.options import Options
    from .encoding import encode_population

    data = dataset.data
    if data.x_dims is None:
        return False
    options = options or Options()
    batch = encode_population([tree], max(tree.count_nodes(), 1), options.operators,
                              device=data.device)
    viol = dimensional_violations_batch(
        batch, data.dims_row, data.x_dims,
        (torch.zeros(N_DIMS, device=data.device) if data.y_dims is None else data.y_dims),
        data.y_dims is not None, options.operators,
        wildcard_constants=not options.dimensionless_constants_only)
    return bool(viol[0])
